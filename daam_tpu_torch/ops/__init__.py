"""Attention ops, the feed-forward's GEGLU gate, and the hand-written CUDA
kernels behind them."""
