"""TBPTT training: the harness, early stopping and checkpoints."""
