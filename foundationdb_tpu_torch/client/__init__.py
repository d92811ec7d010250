"""Client API (ref: fdbclient/ — NativeAPI + ReadYourWrites)."""

from .transaction import (RETRYABLE, Database, Transaction,
                          run_transaction)

__all__ = ["RETRYABLE", "Database", "Transaction", "run_transaction"]
