import sys

from anomod_torch.cli import main

sys.exit(main())
