"""Service layer of the port: the shared reactor (``service/reactor.py``) and
the popularity tier's decoded-block cache (``service/eviction.py``
``ServeCache``).

Port of ``sparkucx_tpu/service`` without the tenant registry and the
eviction manager (ROADMAP queue A items 5 and 7).
"""

from sparkucx_tpu_torch.service.eviction import ServeCache
from sparkucx_tpu_torch.service.reactor import Reactor

__all__ = ["Reactor", "ServeCache"]
