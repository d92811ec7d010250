"""`fdb`-style Python binding surface.

Reference: bindings/python/fdb — the API programmers actually use:
``fdb.open()``, ``@fdb.transactional``, ``db[key]`` sugar, and the
tuple/subspace layers under ``fdb.tuple`` / ``fdb.Subspace``. The
reference binding is blocking over the C ABI's network thread; this
framework's client is cooperative, so the surface is async — a
``@transactional`` function is an async function whose first argument
is bound to a retried Transaction, and the item sugar lives on the
async Transaction itself.
"""

from __future__ import annotations

import functools

from ..client import Database, Transaction, run_transaction
from ..layers import Subspace
from ..layers import tuple_layer as tuple  # noqa: A001 — mirrors fdb.tuple
from ..server.types import KeySelector

__all__ = ["open", "transactional", "Database", "Transaction",
           "Subspace", "tuple", "KeySelector", "api_version",
           "threadsafe_database"]

# -- API versioning (ref: fdb.api_version + the MultiVersion client's
# version selection, fdbclient/MultiVersionTransaction.actor.cpp:
# the binding locks to one API version per process; a conflicting
# second selection is an error). Version numbers track the reference's
# (520+ = versionstamp ops in tuples, 610+ = current surface).
CURRENT_API_VERSION = 710
_selected_api_version = None


def api_version(version: int) -> None:
    global _selected_api_version
    if _selected_api_version is not None:
        if version != _selected_api_version:
            raise RuntimeError(
                f"API version already selected: {_selected_api_version}")
        return
    if not 500 <= version <= CURRENT_API_VERSION:
        raise RuntimeError(
            f"API version {version} not supported (500..."
            f"{CURRENT_API_VERSION})")
    _selected_api_version = version


def threadsafe_database(host: str, port: int):
    """A THREAD-SAFE blocking Database handle — the native C client over
    a cluster's TcpGateway (ref: ThreadSafeDatabase in
    fdbclient/ThreadSafeTransaction.cpp — the layer OS-thread callers
    use; here that layer IS the C binding, whose connection owns its
    reader thread and whose calls may come from any thread)."""
    from .c_client import CDatabase
    return CDatabase(host, port)


def open(cluster, name: str = "fdb-client"):  # noqa: A001 — mirrors fdb.open
    """A Database handle onto a running cluster (ref: fdb.open — the
    cluster-file argument becomes the SimCluster here)."""
    return cluster.client(name)


def transactional(func):
    """(ref: @fdb.transactional — the wrapped function receives a
    transaction as its first argument and is retried on retryable
    errors; passing a Database starts the retry loop, passing a
    Transaction composes without a nested loop)"""

    @functools.wraps(func)
    async def wrapper(db_or_tr, *args, **kwargs):
        if isinstance(db_or_tr, Transaction):
            return await func(db_or_tr, *args, **kwargs)

        async def body(tr):
            return await func(tr, *args, **kwargs)
        return await run_transaction(db_or_tr, body)

    return wrapper
