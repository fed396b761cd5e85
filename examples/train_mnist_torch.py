"""Distributed MNIST training on the PyTorch port: the worker script of the
rendered job (``JobConfig.script``'s default).

The counterpart of ``examples/train_mnist.py``: one copy runs in every
pod of the Indexed Job, the ``TPUJOB_*`` env the manifest injects forms
the process group (``parallel/distributed.py``), and the job itself is
``k8s_distributed_deeplearning_torch/train/mnist.py`` with the
reference's flags (--lr, --num-steps, --use-adasum, --batch-size, ...).
Runs on the card unless ``--device cpu`` is given.

  python examples/train_mnist_torch.py --num-steps 600
  python -m k8s_distributed_deeplearning_torch.launch run-local --workers 2 \
      -- --device cpu --num-steps 40 --no-eval
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from k8s_distributed_deeplearning_torch.train import mnist  # noqa: E402


def main(argv: list[str] | None = None) -> dict:
    return mnist.main(argv)


if __name__ == "__main__":
    main(sys.argv[1:])
