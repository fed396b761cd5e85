"""Continuous-batching serving over a paged KV pool (PyTorch port)."""
from k8s_distributed_deeplearning_torch.serve.engine import ServeEngine
from k8s_distributed_deeplearning_torch.serve.page_pool import PagePool
from k8s_distributed_deeplearning_torch.serve.request import (
    EngineDraining, QueueFull, Request, RequestOutput, SamplingParams)
from k8s_distributed_deeplearning_torch.serve.scheduler import RequestQueue

__all__ = ["EngineDraining", "PagePool", "QueueFull", "Request",
           "RequestOutput", "RequestQueue", "SamplingParams", "ServeEngine"]
