"""``python -m k8s_distributed_deeplearning_torch.serve``: see serve/cli.py."""
import sys

from k8s_distributed_deeplearning_torch.serve.cli import main

if __name__ == "__main__":
    sys.exit(main())
