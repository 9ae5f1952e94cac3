"""The first step's gradient as SGD with momentum took it, from its state
after that step: the momentum trace less the weight decay it added (the
step moved nothing: its learning rate is 0)."""


def first_grad(p, state: dict, group: dict):
    buf = state.get("momentum_buffer")
    if buf is None:
        return None
    return buf - group["weight_decay"] * p
