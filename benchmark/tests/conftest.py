"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
repository's root.  They run on the CPU at tiny sizes, through the port's
plain versions; tests marked ``cuda`` need the card and skip without it."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# each cell's configuration cut to a CPU test's size
TINY = {"config": {"scene": {"n_tori": 48},
                   "render": {"width": 64, "height": 64},
                   "wavefront": {"width": 32, "height": 32}},
        "params": {"pixels": 1024, "trace_calls": 2, "check_steps": 2}}
