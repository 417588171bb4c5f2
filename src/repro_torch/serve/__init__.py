"""repro_torch.serve — prefill / decode serving and opportunistic sessions.

Multi-tenant serving (``MultiTenantServer``) is not ported yet."""
from .engine import greedy_generate, make_serve_fns
from .session import CacheResult, GenResult, OpportunisticServer

__all__ = ["greedy_generate", "make_serve_fns", "CacheResult", "GenResult",
           "OpportunisticServer"]
