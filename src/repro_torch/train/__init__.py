"""Training: AdamW, the train step, checkpoints, fault tolerance and the
Trainer loop (the reference's ``train/`` on one card)."""
