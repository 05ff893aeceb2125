"""python -m arcanefem_tpu_torch.parallel --nproc P [--device cuda|cpu]
[--sphere H,REFINE] [--f64]: see ``dryrun.py``."""

import sys

from .dryrun import main

if __name__ == "__main__":
    sys.exit(main())
