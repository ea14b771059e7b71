"""Arrow Flight gRPC transport over a :class:`~.service.GraphService`.

Counterpart of ``graph_tpu.server.flight`` (reference analog:
``FlightServiceImpl``, crates/server/src/server.rs:34-576, on
``[::1]:50051``, main.rs:40-56):

* ``do_action``  — JSON actions: create / list / remove / compute /
  to_relabeled / to_undirected (dispatch at server.rs:187-258),
* ``do_put``     — stream an Int64 (source, target) edge list plus a
  ``CreateGraphCommand`` descriptor to build a named graph
  (server.rs:109-177),
* ``do_get``     — stream an algorithm-result property column back as
  record batches of 10,000 rows (server.rs:70-107),
* ``list_actions`` — advertised action types.

The request handling lives in the service, which needs no pyarrow; this
module is the only one of the server that imports it.  Compute runs
inline (the analog of the reference's spawn_blocking).
"""

from __future__ import annotations

import json
import logging

import numpy as np
import pyarrow as pa
import pyarrow.flight as flight

from graph_tpu_torch.server import actions as act
from graph_tpu_torch.server.catalog import chunks
from graph_tpu_torch.server.service import REQUEST_ERRORS, GraphService

log = logging.getLogger("graph_tpu_torch.server")


class GraphFlightServer(flight.FlightServerBase):
    """Flight server whose graphs live on ``device`` (None: the card)."""

    def __init__(self, location="grpc://[::1]:50051", device=None, **kwargs):
        # the service first: without a card nothing binds the port
        self.service = GraphService(device)
        super().__init__(location, **kwargs)

    def list_actions(self, context):
        return [flight.ActionType(t, d) for t, d in act.ACTION_TYPES]

    def do_action(self, context, action):
        try:
            result = self.service.action(action.type, action.body.to_pybytes())
        except REQUEST_ERRORS as e:
            raise flight.FlightServerError(str(e))
        return [act.to_json(result)]

    def do_put(self, context, descriptor, reader, writer):
        # Ingest record batches incrementally (server.rs:109-177 streams
        # batches into the edge list as they arrive): each batch is
        # converted to numpy and released before the next is read, so
        # peak memory is the edge arrays, not the Arrow table + arrays.
        src_chunks, dst_chunks = [], []
        for chunk in reader:
            batch = chunk.data
            src_chunks.append(
                batch.column(0).to_numpy(zero_copy_only=False).astype(np.int64))
            dst_chunks.append(
                batch.column(1).to_numpy(zero_copy_only=False).astype(np.int64))
        src = (np.concatenate(src_chunks) if src_chunks
               else np.zeros(0, np.int64))
        dst = (np.concatenate(dst_chunks) if dst_chunks
               else np.zeros(0, np.int64))
        writer.write(act.to_json(self.service.put(descriptor.command, src, dst)))

    def do_get(self, context, ticket):
        pid = json.loads(ticket.ticket)
        log.info("Received GET request for ticket: %s", pid)
        field_name, values = self.service.properties.get(
            pid["graph_name"], pid["property_key"])
        schema = pa.schema(
            [pa.field(field_name, pa.from_numpy_dtype(values.dtype))])
        batches = [pa.record_batch([pa.array(rows)], schema=schema)
                   for rows in chunks(values)]
        return flight.RecordBatchStream(pa.Table.from_batches(batches))


def serve(location="grpc://[::1]:50051", device=None):
    """main.rs:25-62 analog."""
    logging.basicConfig(level=logging.INFO)
    server = GraphFlightServer(location, device=device)
    log.info("Serving on %s", location)
    server.serve()
