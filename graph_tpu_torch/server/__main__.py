"""Serve graphs over Arrow Flight.

    python -m graph_tpu_torch.server [grpc://host:port] [plan-cache-dir] [device]

Serves on ``device``, the card when it is not given.  A plan-cache
directory sets ``$GRAPH_TPU_TORCH_PLAN_CACHE``, so that EdgePlans persist
across processes.  The port has no compile cache to enable: its kernels
are built at first use into ``graph_tpu_torch/build/``.
"""

import os
import sys


def main(argv):
    from graph_tpu_torch.engine.plan import PLAN_CACHE_ENV

    location = argv[0] if argv else "grpc://[::1]:50051"
    if len(argv) > 1:
        os.environ[PLAN_CACHE_ENV] = argv[1]
    device = argv[2] if len(argv) > 2 else None
    from graph_tpu_torch.server.flight import serve

    serve(location, device=device)


if __name__ == "__main__":
    main(sys.argv[1:])
