"""Multi-tenant search serving (``repro.serve``).

The serving layer over the engine and the block cache:

  * ``scheduler`` — the coalesced query-major priority walk: concurrent
    tenants' exact walks interleaved by urgency over ONE cache, every
    block fetched once for all tenants that need it;
  * ``coalescer`` — admission: ``SearchSession.submit`` queues batches
    as ``Ticket``s, ``drain`` answers everything pending in one walk;
  * ``anytime`` — certified anytime answers: ``certify`` turns any
    deadline-cut walk state into a two-sided bound on the true k-th
    distance, ``AnytimeResult.refine_to_exact`` upgrades to the exact
    answer without repeating work.

Entry points are on ``storage.SearchSession`` (``submit`` / ``drain``,
``search(deadline_blocks=...)``); this package holds the machinery.
"""
from repro_torch.serve.anytime import (AnytimeCertificate, AnytimeResult,  # noqa: F401
                                       certify)
from repro_torch.serve.coalescer import AdmissionCoalescer, Ticket  # noqa: F401
from repro_torch.serve.scheduler import (TenantRun, coalesced_walk,  # noqa: F401
                                         prepare_tenant)
