import sys

from nsc_tpu_torch.train.loop import main

sys.exit(main())
