import sys

from lmvnbench.run import main

sys.exit(main())
