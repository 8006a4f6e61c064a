from repro_torch.serve.engine import (DenseSlotPool, Request, ServeEngine,
                                      bucket_len)
from repro_torch.serve.kv_cache import OutOfPages, PagedKVCache
from repro_torch.serve.scheduler import Scheduler

__all__ = ["ServeEngine", "Request", "DenseSlotPool", "bucket_len",
           "PagedKVCache", "OutOfPages", "Scheduler"]
