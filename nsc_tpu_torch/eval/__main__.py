import sys

from nsc_tpu_torch.eval.sweep import main

sys.exit(main())
