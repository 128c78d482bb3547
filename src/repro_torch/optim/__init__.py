"""Optimizers of the port: pure-tree SGD / AdamW, minibatch-prox as an LM
optimizer (MBProx) and gradient compression for its sync points."""
