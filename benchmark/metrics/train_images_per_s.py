"""train_images_per_s (images/s, host clock): the images of every step
completed in the window, over all its chips, over the window's seconds
between its two synchronisations."""


def read(run):
    if run.window_s <= 0:
        return None
    return run.window_rows / run.window_s
