"""``python -m k8s_distributed_deeplearning_torch.train``: see train/cli.py."""
import sys

from k8s_distributed_deeplearning_torch.train.cli import main

if __name__ == "__main__":
    main(sys.argv[1:])
