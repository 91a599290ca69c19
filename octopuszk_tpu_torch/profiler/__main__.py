import sys

from octopuszk_tpu_torch.profiler.profiler import main

if __name__ == "__main__":
    sys.exit(main())
