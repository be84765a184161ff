"""Inputs made on the device from the run's seed: problem data and the
untrained weights, the same for the same seed."""
