"""Training: losses, schedules, the optimizer chains and the parameter EMA,
the train/eval steps, hooks and the Trainer loop (single device)."""
