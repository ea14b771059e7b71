"""Arrow Flight service (reference: crates/server).

Counterpart of ``graph_tpu.server``.  The request path
(:mod:`.service`, :mod:`.catalog`, :mod:`.actions`) needs no pyarrow;
only the Flight transport (:mod:`.flight`) does, so the names are
imported lazily and the core library works without it.
"""

__all__ = ["GraphFlightServer", "GraphService", "serve"]


def __getattr__(name):
    if name == "GraphService":
        from graph_tpu_torch.server.service import GraphService

        return GraphService
    if name in __all__:
        from graph_tpu_torch.server.flight import GraphFlightServer, serve

        return {"GraphFlightServer": GraphFlightServer, "serve": serve}[name]
    raise AttributeError(name)
