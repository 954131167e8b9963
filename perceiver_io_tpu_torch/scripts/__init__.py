"""Training and serving CLI of the port: the dataclass flag engine and the
driver (:mod:`perceiver_io_tpu_torch.scripts.cli`) and one entry point per
ported model family. Counterpart of ``perceiver_io_tpu/scripts``."""
