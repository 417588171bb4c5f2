"""repro_torch.serve — prefill / decode serving, opportunistic sessions, and
multi-tenant serving.

Multi-tenant serving (``MultiTenantServer``) lives in its own module and
imports only the core layer, so trace-replay tests can use it without the
model stack."""
from .engine import greedy_generate, make_serve_fns
from .multitenant import MultiTenantServer, TenantProgram
from .session import CacheResult, GenResult, OpportunisticServer

__all__ = ["greedy_generate", "make_serve_fns", "CacheResult", "GenResult",
           "MultiTenantServer", "OpportunisticServer", "TenantProgram"]
