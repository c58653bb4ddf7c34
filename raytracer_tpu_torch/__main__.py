import sys

from raytracer_tpu_torch.cli import main

sys.exit(main())
