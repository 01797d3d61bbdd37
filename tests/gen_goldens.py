"""Regenerate the frozen golden outputs (tests/goldens/). Run on the CPU
backend so goldens are platform-independent (cross-backend equality is
asserted separately)."""

import os
import shutil
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import golden_configs  # noqa: E402


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    gold = os.path.join(here, "goldens")
    os.makedirs(gold, exist_ok=True)
    with tempfile.TemporaryDirectory() as td:
        produced = golden_configs.run_all(td)
        for rel in produced:
            shutil.copy2(os.path.join(td, rel), os.path.join(gold, rel))
            print("wrote", rel)


if __name__ == "__main__":
    main()
