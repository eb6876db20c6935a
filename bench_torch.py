#!/usr/bin/env python3
"""The PyTorch/CUDA port's bench, ``dolfinx_eqlb_tpu_torch.bench``, from the
root of a checkout:

    python bench_torch.py [n] [n_fields] [--stress] [--mixed] [--biot]
        [--device cpu]

Two JSON lines on stdout, strict latency first; see the module's
docstring.  Runs on the CUDA card unless ``--device`` says otherwise.
"""

import sys

from dolfinx_eqlb_tpu_torch.bench import cli

if __name__ == "__main__":
    sys.exit(cli())
