"""Dispatch pipelining of the PyTorch port (``pipeline``); multi-GPU
execution is ROADMAP.md queue A item 10."""
