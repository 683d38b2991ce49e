"""Clustering stage and pipeline of the port: eager k-means reference, the
CHW Lloyd and maximin kernels (K2, K4), the coarse warm-start kernel (K3)
and the labels-only pipeline."""
