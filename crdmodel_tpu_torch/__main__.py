import sys

from crdmodel_tpu_torch.cli import main

sys.exit(main())
