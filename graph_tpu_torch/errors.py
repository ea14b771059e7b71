"""Error types (the port's own copy of ``graph_tpu.errors``).

Mirrors the reference's ``thiserror`` enum (crates/builder/src/lib.rs:274-302)
as a small exception hierarchy.  The framework is fail-fast, like the
reference: no retries, no elastic recovery.
"""


class GraphError(Exception):
    """Base error for graph_tpu_torch (reference: builder/src/lib.rs:274)."""


class InvalidIdType(GraphError):
    """Binary snapshot was written with a different id dtype.

    Reference analog: ``Error::InvalidIdType`` raised on type-name mismatch
    during CSR deserialization (crates/builder/src/graph/csr.rs:285-290).
    """

    def __init__(self, expected: str, actual: str):
        super().__init__(
            f"Invalid id dtype: expected {expected!r}, got {actual!r}"
        )
        self.expected = expected
        self.actual = actual


class InvalidNodeValues(GraphError):
    """Node-value array length does not match node count.

    Reference analog: ``Error::InvalidNodeValues`` (builder/src/lib.rs).
    """


class InvalidPartitioning(GraphError):
    """Invalid degree-partitioning request (builder/src/lib.rs analog)."""


class GraphNotFound(GraphError):
    """Named graph missing from the catalog (server/src/catalog.rs:144)."""

