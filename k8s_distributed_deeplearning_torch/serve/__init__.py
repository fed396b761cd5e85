"""Continuous-batching serving over a paged KV pool (PyTorch port)."""
from k8s_distributed_deeplearning_torch.serve.engine import ServeEngine
from k8s_distributed_deeplearning_torch.serve.page_pool import PagePool
from k8s_distributed_deeplearning_torch.serve.prefix_cache import PrefixCache
from k8s_distributed_deeplearning_torch.serve.request import (
    EngineDraining, QueueFull, Request, RequestOutput, SamplingParams)
from k8s_distributed_deeplearning_torch.serve.sched import (
    TenantConfig, TenantScheduler, load_tenants, parse_tenants)

__all__ = ["EngineDraining", "PagePool", "PrefixCache", "QueueFull",
           "Request", "RequestOutput", "SamplingParams",
           "ServeEngine", "TenantConfig", "TenantScheduler", "load_tenants",
           "parse_tenants"]
