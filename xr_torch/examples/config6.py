"""Config 6: `python -m xr_torch.examples.config6 [run.py's flags]`, a thin
wrapper over xr_torch.examples.run."""
import sys

from xr_torch.examples.run import main

if __name__ == "__main__":
    sys.argv.insert(1, "config6")
    main()
