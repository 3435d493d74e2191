"""Ops: the LSTM recurrence kernels (K2/K3) with autograd, bf16 products, CE loss."""
