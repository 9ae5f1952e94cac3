"""train_tokens_per_s (tokens/s, host clock): the real (attention-mask)
tokens of every step completed in the window, over the window's seconds
between its two synchronisations."""


def read(run):
    if run.window_s <= 0 or run.window_tokens <= 0:
        return None
    return run.window_tokens / run.window_s
