"""Device ops: quantize, packed layout, distances, top-k, scans, kernels."""
