"""One ``torchrun`` rank of the port's CLI over a mesh
(``test_torch_port_parallel_train.py``): the CLM family with an fp32
model (the family's default is bf16), one intra-op thread, then
``CLI.main(argv)``."""
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from perceiver_io_tpu_torch.models.text.clm import CausalLanguageModel  # noqa: E402
from perceiver_io_tpu_torch.scripts import cli  # noqa: E402
from perceiver_io_tpu_torch.scripts.text import clm  # noqa: E402

if __name__ == "__main__":
    torch.set_num_threads(1)
    family = dataclasses.replace(clm.FAMILY, build_model=lambda cfg, dm, **kw: CausalLanguageModel(cfg, **kw))
    cli.CLI(family).main(sys.argv[1:])
