"""Config 2: `python -m xr_torch.examples.config2 [run.py's flags]`, a thin
wrapper over xr_torch.examples.run."""
import sys

from xr_torch.examples.run import main

if __name__ == "__main__":
    sys.argv.insert(1, "config2")
    main()
