"""Load the checkout's scripts/*.py as modules: scripts/ is not a package,
and the zoo scripts, chip_smoke.py and the tests share functions of
scripts/torch_zoo.py and its neighbours."""

import importlib.util
import os

SCRIPTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "scripts")


def load_script(name: str):
    """scripts/<name>.py, executed as a fresh module named `name`."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
