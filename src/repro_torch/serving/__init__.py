"""Corpus-precomputation serving subsystem for DPLR-FwFM.  Port of
``repro.serving`` for one device, with the same exports.

The stack is three layers: shared compute, per-tenant state, shared
request routing.

  * ``ScorerRuntime`` (shared) owns everything corpus-independent: the
    context cache and the dispatch to the corpus kernels.  T tenants
    share one runtime.
  * ``CorpusState`` (per tenant) is the mutable corpus: a capacity-padded
    slab with a validity mask, a free-list, the params snapshot and the
    tenant's ``on_mutate`` writer barrier.  ``CorpusRankingEngine`` is an
    alias.
  * ``QueryFrontend`` (shared) is the online request path: per-tenant EDF
    queues coalescing into power-of-two micro-batches, weighted fairness
    across tenants, an in-flight window, admission control, retries,
    breakers and a per-tenant writer barrier.

    corpus.py   - ItemCorpusCache, build_corpus_cache, corpus_rows,
                  masked_slab_scores
    runtime.py  - ScorerRuntime
    engine.py   - CorpusState / CorpusRankingEngine, fused_topk
    frontend.py - QueryFrontend, PendingQuery
    rpc.py      - RpcServer / RpcClient: the reference's binary wire
                  protocol, byte for byte
    errors.py   - the typed ServingError hierarchy
    faults.py   - FaultInjector (seeded, scripted fault sites)
    sanitize.py - REPRO_SANITIZE: scoring_guard, check_scores,
                  assert_no_retrace

Every name of the reference's ``__all__`` has a counterpart here.  The
reference's ``sharded.py`` exports nothing through this module, and is
not ported yet.
"""
from repro_torch.serving.corpus import (
    ItemCorpusCache,
    build_corpus_cache,
    corpus_rows,
    masked_slab_scores,
)
from repro_torch.serving.engine import CorpusRankingEngine, CorpusState
from repro_torch.serving.errors import (
    DeadlineExceeded,
    Degraded,
    DispatchFailed,
    FrontendError,
    NotReady,
    Overloaded,
    RefreshFailed,
    ServingError,
    Unservable,
)
from repro_torch.serving.faults import FaultInjector, InjectedFault
from repro_torch.serving.frontend import PendingQuery, QueryFrontend
from repro_torch.serving.rpc import (
    RpcClient,
    RpcDisconnected,
    RpcProtocolError,
    RpcServer,
    serve_in_thread,
)
from repro_torch.serving.runtime import ScorerRuntime
from repro_torch.serving.sanitize import (
    assert_no_retrace,
    check_scores,
    sanitize_enabled,
    scoring_guard,
)

__all__ = ["ItemCorpusCache", "build_corpus_cache", "corpus_rows",
           "masked_slab_scores", "ScorerRuntime", "CorpusState",
           "CorpusRankingEngine", "QueryFrontend", "PendingQuery",
           "ServingError", "Overloaded", "DeadlineExceeded", "Unservable",
           "DispatchFailed", "RefreshFailed", "Degraded", "NotReady",
           "FrontendError", "FaultInjector", "InjectedFault",
           "RpcServer", "RpcClient", "RpcProtocolError", "RpcDisconnected",
           "serve_in_thread",
           "assert_no_retrace", "check_scores", "sanitize_enabled",
           "scoring_guard"]
