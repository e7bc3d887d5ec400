from repro_torch.data.multi_tenant import (TenantSpec, default_tenants,
                                     make_multi_tenant_workload)
from repro_torch.data.trace import BurstyTrace
from repro_torch.data.workload import make_offline_corpus, make_online_requests

__all__ = ["BurstyTrace", "TenantSpec", "default_tenants",
           "make_multi_tenant_workload", "make_offline_corpus",
           "make_online_requests"]
