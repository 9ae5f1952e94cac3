"""Training: losses, schedules, the AdamW chain, the train/eval steps,
hooks and the Trainer loop (single device)."""
