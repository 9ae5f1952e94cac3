"""The first step's gradient as AdamW took it, from its state after that
step: the first moment over (1 − β1)."""


def first_grad(p, state: dict, group: dict):
    if "exp_avg" not in state:
        return None
    return state["exp_avg"] / (1.0 - group["betas"][0])
