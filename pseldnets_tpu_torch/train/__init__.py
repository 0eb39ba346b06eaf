"""Training: the weight bridge, losses' optimizer, the fused training forward
and the SELDTask train step."""
