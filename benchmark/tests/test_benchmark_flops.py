"""The model FLOP counts the ``mfu.*`` metrics divide by."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchlib import spec, traffic as traffic_lib, weights
from reference import bert, common, resnet
from tiny import BERT, RESNET, SEED


def _exp(cell: str, tiny: dict | None) -> tuple[dict, dict]:
    """The experiment as a run of ``cell`` (at the tiny sizes) runs it."""
    from benchlib import cell as cell_lib
    tiny = tiny or {}
    work = {**spec.workload(cell), **tiny.get("work", {})}
    tr = {**spec.traffic(work["traffic"]), **tiny.get("traffic", {})}
    return cell_lib.build_config(spec.config(work["config"]), work, tr,
                                 tiny.get("extra", [])).to_dict(), tr


def test_bert_formula_counts_the_reference_products():
    """3 × the forward's products of a tiny BERT, counted by torch's own
    FLOP counter over the reference's forward (the head at the masked
    positions only), is the formula's step count."""
    exp, tr = _exp("bert-base-mlm.s512-b96", BERT)
    batch = traffic_lib.make_batch(tr, exp["data"], SEED, 0, 0, "cpu")
    batch["attention_mask"][1, 40:] = 0  # a shorter row counts less
    params = weights.make(bert.param_specs(exp), SEED, "cpu")
    with FlopCounterMode(display=False) as counter:
        bert._masked_ce_sum(params, exp, batch["input_ids"],
                            batch["attention_mask"], batch["targets"],
                            None, common.Ops())
    counted = counter.get_total_flops()
    formula = bert.step_flops(exp, batch)
    # The reference computes the padding too (projections of every
    # position, attention over every key, masked); the formula counts a
    # row's real tokens: add back what the padding took.
    m = exp["model"]
    h, f, layers = m["hidden_size"], m["mlp_dim"], m["num_layers"]
    rows, seq = batch["input_ids"].shape
    lengths = batch["attention_mask"].sum(1).double()
    pad_tokens = rows * seq - float(lengths.sum())
    padded = (4.0 * float((seq ** 2 - lengths ** 2).sum()) * h * layers
              + 2.0 * pad_tokens * layers * (4 * h * h + 2 * h * f))
    assert 3 * counted == pytest.approx(formula + 3 * padded, rel=1e-12)


def test_bert_base_flops_per_token():
    """At the cell's widths a token costs ~590 MFLOP of model work with
    15% of the positions masked (the issue's estimate)."""
    exp, tr = _exp("bert-base-mlm.s512-b96", None)
    batch = traffic_lib.make_batch(tr, exp["data"], SEED, 0, 0, "cpu")
    per_token = bert.step_flops(exp, batch) / batch["input_ids"].numel()
    assert 5.5e8 < per_token < 6.5e8


def test_resnet50_count_against_he_et_al():
    """He et al. give 3.8 × 10⁹ multiply-adds for ResNet-50 at 224 (the
    stride on the first 1×1, the 7×7 stem). The configuration moves the
    stride to the 3×3 (+0.23 × 10⁹) and takes the space-to-depth stem,
    which adds (12,288 − 9,408) weights × 112² positions."""
    exp, _ = _exp("resnet50-imagenet.i224-b256", None)
    paper = resnet.forward_macs(exp, 224, stem="7x7", stride_on="1x1")
    assert paper == pytest.approx(3.8e9, rel=0.025)
    v15 = resnet.forward_macs(exp, 224, stem="7x7")
    assert 4.0e9 < v15 < 4.2e9
    s2d = resnet.forward_macs(exp, 224)
    assert s2d - v15 == (12288 - 9408) * 112 * 112


def test_resnet_count_matches_the_reference_convolutions():
    exp, tr = _exp("resnet50-imagenet.i224-b256", RESNET)
    batch = traffic_lib.make_batch(tr, exp["data"], SEED, 0, 0, "cpu")
    params = weights.make(resnet.param_specs(exp), SEED, "cpu")
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        resnet.forward(params, exp, batch["image"], {},
                       common.Ops())
    assert 3 * counter.get_total_flops() == pytest.approx(
        resnet.step_flops(exp, batch), rel=1e-12)
