"""Data for training and calibration: a byte tokenizer and synthetic tasks
(numpy only, as in the JAX package)."""
