"""Model zoo: the MNIST ConvNet (the reference's own model) and the
scale-out families on the shared transformer core (Llama, MoE, BERT, ViT)
and ResNet; weight converters and generation."""

from k8s_distributed_deeplearning_torch.models.mnist import MNISTConvNet  # noqa: F401
from k8s_distributed_deeplearning_torch.models.transformer import (  # noqa: F401
    Transformer,
    TransformerConfig,
)
from k8s_distributed_deeplearning_torch.models.llama import LlamaLM  # noqa: F401
from k8s_distributed_deeplearning_torch.models.bert import BertMLM  # noqa: F401
from k8s_distributed_deeplearning_torch.models.vit import ViT  # noqa: F401
from k8s_distributed_deeplearning_torch.models.resnet import ResNet  # noqa: F401
from k8s_distributed_deeplearning_torch.models.moe import MoELM, MoEConfig  # noqa: F401
from k8s_distributed_deeplearning_torch.models import generate  # noqa: F401  (module; use models.generate.generate)
