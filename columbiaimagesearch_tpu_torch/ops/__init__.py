"""Training ops of the port: k-means, PCA, local rotations (port of
columbiaimagesearch_tpu/ops/)."""
