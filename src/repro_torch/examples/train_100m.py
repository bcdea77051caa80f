"""End-to-end driver: train a ~100M-param model for a few hundred steps
with checkpointing + restart resilience.

    PYTHONPATH=src python -m repro_torch.examples.train_100m [--steps 200]

Counterpart of ``examples/train_100m.py`` over
``repro_torch.launch.train.main`` with the same defaults, on the card
unless ``--device cpu`` is given.  The checkpoint directory defaults to
one in the system's temporary directory.
"""
import os
import sys
import tempfile

from repro_torch.launch.train import main


def defaults():
    return ["--arch", "tinyllama-1.1b", "--reduce", "width",
            "--steps", "200", "--batch", "8", "--seq", "256",
            "--ckpt", os.path.join(tempfile.gettempdir(), "repro_100m_ckpt"),
            "--ckpt-every", "50"]


if __name__ == "__main__":
    # user args win
    main(defaults() + sys.argv[1:])
