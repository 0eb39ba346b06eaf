"""Feature frontend and the kernel wrappers (K1: frontend, K2: Swin block,
K3: its backward, K4/K5: the Swin block with adapters and its backward)."""
