"""Bundle-adjustment LM pipelines over plain tensors (counterpart of
ceres_tpu/parallel/): the single-device half of sharded_ba.py."""
