"""chip_smoke.py loaded as a module: the port's tests share its field
makers, oracle constants and K3/K4 edge cases.  Imports neither jax nor
sz_tpu, so the card tests can use it where jax is absent."""

import importlib.util
import pathlib

REPO = pathlib.Path(__file__).resolve().parent.parent

_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               REPO / "chip_smoke.py")
SMOKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(SMOKE)
