"""The port's training-mode BatchNorm (models/layers.py) against Flax's
``nn.BatchNorm``, on the one-device path (``F.batch_norm``'s statistics)
and through the cross-rank Function at a world of 1 with no process group
(its ``E[x²] − E[x]²`` over f32 sums, the collectives skipped).

Each case holds ``y``, the batch mean and variance, the running statistics
after the update (momentum 0.9, the biased variance) and the gradients of
x, scale and bias of ``sum(y * g)``, with the same inputs and weights (NHWC
in Flax, its NCHW view in the port), and an exact float64 evaluation of
the same formula beside them:

* ``ordinary`` activations (mean 0.5, std 1.5): everything within 1e-5 of
  each quantity's largest value (the default f32 tolerance; sums in other
  orders), against Flax and against the float64 evaluation; ``y`` also
  within 8 f32 roundings at max|x| times γ/σ (x − E[x] rounds at |x|),
  and dscale and dbias, sums of N·H·W terms, within ε times the sum of
  their terms' magnitudes.
* ``offset`` activations, as after a ReLU far from zero (mean 30, std 0.5)
  over N·H·W = 2^16 per channel, where the two variance formulas part:
  Flax's ``E[x²] − E[x]²`` cancels 900 against 900 in f32, and its f32
  sums carry a rounding of about ε·E[x²]·√n (ε = 2^-24), which is 1.4e-2
  here against a variance of 0.25 (observed for Flax on the CPU: up to
  1.7% of the variance). So Flax is held to the port within that bound
  (the variance), within ε·|E[x]|·√n (the mean), and within the relative
  error it implies for the normalised quantities (y, dx and dscale:
  bound / (2·var), of each one's largest value). The port's one-device
  path is held to the float64 evaluation at 1e-5: its statistics are a
  Welford sum (torch), so it is the exact one of the three. The
  Function's sums are f32 like Flax's, so it gets Flax's bound.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from distributed_tensorflow_framework_torch.models.layers import BatchNorm

EPS = 1e-5
MOMENTUM = 0.9
F32_EPS = 2.0 ** -24
CASES = {"ordinary": ((8, 6, 6, 5), 0.5, 1.5),
         "offset": ((64, 32, 32, 4), 30.0, 0.5)}


def _inputs(case):
    shape, mean, std = CASES[case]
    rng = np.random.default_rng(len(shape) + int(mean))
    c = shape[-1]
    x = np.maximum(mean + std * rng.standard_normal(shape), 0.0)
    return {"x": x.astype(np.float32),
            "g": rng.standard_normal(shape).astype(np.float32),
            "scale": (1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(c)).astype(np.float32),
            "ra_mean": (0.1 * rng.standard_normal(c)).astype(np.float32),
            "ra_var": (1 + 0.5 * rng.random(c)).astype(np.float32)}


def _batch_stats(ra_old, ra_new):
    """The batch statistic an update folded in: (new − 0.9·old) / 0.1."""
    return ((np.asarray(ra_new, np.float64)
             - MOMENTUM * np.asarray(ra_old, np.float64)) / (1 - MOMENTUM))


def _flax(inp):
    bn = fnn.BatchNorm(use_running_average=False, momentum=MOMENTUM,
                       epsilon=EPS)
    variables = {"params": {"scale": inp["scale"], "bias": inp["bias"]},
                 "batch_stats": {"mean": inp["ra_mean"],
                                 "var": inp["ra_var"]}}

    def loss(x, params):
        y, state = bn.apply({**variables, "params": params}, x,
                            mutable=["batch_stats"])
        return jnp.sum(y * inp["g"]), (y, state["batch_stats"])

    (_, (y, stats)), (dx, dp) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(inp["x"], variables["params"])
    return {"y": y, "mean": _batch_stats(inp["ra_mean"], stats["mean"]),
            "var": _batch_stats(inp["ra_var"], stats["var"]),
            "ra_mean": stats["mean"], "ra_var": stats["var"], "dx": dx,
            "dscale": dp["scale"], "dbias": dp["bias"]}


def _port(inp, cross_rank):
    c = inp["x"].shape[-1]
    bn = BatchNorm(c)
    bn.cross_rank = cross_rank
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inp["scale"]))
        bn.bias.copy_(torch.from_numpy(inp["bias"]))
        bn.running_mean.copy_(torch.from_numpy(inp["ra_mean"]))
        bn.running_var.copy_(torch.from_numpy(inp["ra_var"]))
    bn.train()
    x = torch.from_numpy(inp["x"]).requires_grad_()
    y = bn(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    (y * torch.from_numpy(inp["g"])).sum().backward()
    return {"y": y, "mean": _batch_stats(inp["ra_mean"], bn.running_mean),
            "var": _batch_stats(inp["ra_var"], bn.running_var),
            "ra_mean": bn.running_mean, "ra_var": bn.running_var,
            "dx": x.grad, "dscale": bn.weight.grad, "dbias": bn.bias.grad}


def _exact(inp):
    """The same function in float64: batch statistics, y, the updated
    running statistics and the gradients of sum(y * g)."""
    x, g = (np.asarray(inp[k], np.float64) for k in ("x", "g"))
    axes = (0, 1, 2)
    mean, var = x.mean(axes), x.var(axes)
    invstd = 1.0 / np.sqrt(var + EPS)
    xhat = (x - mean) * invstd
    gamma = np.asarray(inp["scale"], np.float64)
    return {"y": xhat * gamma + inp["bias"], "mean": mean, "var": var,
            "ra_mean": MOMENTUM * inp["ra_mean"].astype(np.float64)
            + (1 - MOMENTUM) * mean,
            "ra_var": MOMENTUM * inp["ra_var"].astype(np.float64)
            + (1 - MOMENTUM) * var,
            "dx": gamma * invstd * (g - g.mean(axes)
                                    - xhat * (g * xhat).mean(axes)),
            "dscale": (g * xhat).sum(axes), "dbias": g.sum(axes)}


def _strict(inp, exact):
    """1e-5 of each quantity's largest value; for y also a few f32
    roundings at x's own magnitude, scaled by γ/σ (x − E[x] rounds at
    |x|, not at |x − E[x]|)."""
    tol = {k: 1e-5 * np.abs(v).max() for k, v in exact.items()}
    x = np.asarray(inp["x"], np.float64)
    gain = np.abs(inp["scale"]) / np.sqrt(exact["var"] + EPS)
    tol["y"] += 8 * F32_EPS * np.abs(x).max() * gain.max()
    # dscale and dbias are sums of n terms: an f32 sum may be off by ε
    # times the sum of their magnitudes.
    g = np.asarray(inp["g"], np.float64)
    xhat = (x - exact["mean"]) / np.sqrt(exact["var"] + EPS)
    tol["dscale"] += F32_EPS * np.abs(g * xhat).sum((0, 1, 2)).max()
    tol["dbias"] += F32_EPS * np.abs(g).sum((0, 1, 2)).max()
    return tol


def _tolerances(inp, exact):
    """The strict tolerance, plus on ill-conditioned input the f32 sums'
    rounding of E[x²]."""
    n = math.prod(inp["x"].shape[:-1])
    top = {k: np.abs(v).max() for k, v in exact.items()}
    tol = _strict(inp, exact)
    x = np.asarray(inp["x"], np.float64)
    var_bound = (F32_EPS * (x * x).mean((0, 1, 2)) * math.sqrt(n)).max()
    mean_bound = (F32_EPS * np.abs(x.mean((0, 1, 2))) * math.sqrt(n)).max()
    rel = var_bound / (2 * (exact["var"].min() + EPS))
    if rel > 1e-5:  # the cancellation is worse than f32 rounding
        tol["var"] += var_bound
        tol["ra_var"] += (1 - MOMENTUM) * var_bound
        tol["mean"] += mean_bound
        tol["ra_mean"] += (1 - MOMENTUM) * mean_bound
        for k in ("y", "dx", "dscale"):
            tol[k] += rel * top[k]
    return tol


def _np(v):
    return (v.detach().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v)).astype(np.float64)


def _assert_within(got, want, tol, what):
    for key, t in tol.items():
        err = np.abs(_np(got[key]) - _np(want[key])).max()
        assert err <= t, f"{what} {key}: {err:.3e} > {t:.3e}"


@pytest.mark.parametrize("path", ["one_device", "function_no_group"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_batchnorm_matches_flax(case, path):
    inp = _inputs(case)
    exact = _exact(inp)
    port = _port(inp, cross_rank=path == "function_no_group")
    flax = _flax(inp)
    strict = _strict(inp, exact)
    loose = _tolerances(inp, exact)
    _assert_within(port, flax, loose, f"{case} {path} vs Flax")
    # The one-device statistics are torch's Welford sums: exact to f32
    # rounding on either input. The Function's are f32 sums, as Flax's.
    _assert_within(port, exact,
                   strict if path == "one_device" else loose,
                   f"{case} {path} vs float64")
    _assert_within(flax, exact, loose, f"{case} Flax vs float64")
    if case == "ordinary":
        assert loose == strict  # well conditioned: the default tolerance
