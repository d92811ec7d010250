"""Error model: numbered errors matching the reference's registry.

Reference: flow/error_definitions.h, flow/Error.h. Error codes are kept
numerically identical so that clients/tools written against the reference's
error surface behave the same here.
"""

from __future__ import annotations


class FdbError(Exception):
    """A numbered framework error (ref: flow/Error.h `class Error`)."""

    __slots__ = ("code", "name")

    def __init__(self, name: str, code: int, message: str = ""):
        super().__init__(message or name)
        self.name = name
        self.code = code

    def __repr__(self) -> str:  # pragma: no cover
        return f"FdbError({self.name}, {self.code})"

    def __eq__(self, other) -> bool:
        return isinstance(other, FdbError) and other.code == self.code

    def __hash__(self) -> int:
        return hash(self.code)

    def is_retryable(self) -> bool:
        """Client retry classification (ref: fdbclient/NativeAPI.actor.cpp onError)."""
        return self.code in _RETRYABLE

    def clone(self) -> "FdbError":
        return FdbError(self.name, self.code, str(self))


_REGISTRY: dict[str, tuple[int, str]] = {}


def _define(name: str, code: int, message: str) -> None:
    _REGISTRY[name] = (code, message)


# Subset of flow/error_definitions.h used by this framework; codes identical.
_define("success", 0, "Success")
_define("end_of_stream", 1, "End of stream")
_define("operation_failed", 1000, "Operation failed")
_define("wrong_shard_server", 1001, "Shard is not available from this server")
_define("timed_out", 1004, "Operation timed out")
_define("coordinated_state_conflict", 1005, "Conflict occurred while changing coordination information")
_define("all_alternatives_failed", 1006, "All alternatives failed")
_define("transaction_too_old", 1007, "Transaction is too old to perform reads or be committed")
_define("no_more_servers", 1008, "Not enough physical servers available")
_define("future_version", 1009, "Request for future version")
_define("tlog_stopped", 1011, "TLog stopped")
_define("proxy_memory_limit_exceeded", 1042,
        "Proxy commit memory limit exceeded")
_define("server_request_queue_full", 1012, "Server request queue is full")
_define("not_committed", 1020, "Transaction not committed due to conflict with another transaction")
_define("commit_unknown_result", 1021, "Transaction may or may not have committed")
_define("transaction_cancelled", 1025, "Operation aborted because the transaction was cancelled")
_define("connection_failed", 1026, "Network connection failed")
_define("coordinators_changed", 1027, "Coordination servers have changed")
_define("request_maybe_delivered", 1030, "Request may or may not have been delivered")
_define("transaction_timed_out", 1031, "Operation aborted because the transaction timed out")
_define("process_behind", 1037, "Storage process does not have recent mutations")
_define("database_locked", 1038, "Database is locked")
_define("broken_promise", 1100, "Broken promise")
_define("operation_cancelled", 1101, "Asynchronous operation cancelled")
_define("future_released", 1102, "Future has been released")
_define("worker_removed", 1202, "Normal worker shut down")
_define("master_recovery_failed", 1203, "Master recovery failed")
_define("master_tlog_failed", 1205, "Master terminating because a TLog failed")
_define("please_reboot", 1207, "Reboot of server process requested")
_define("please_reboot_delete", 1208, "Reboot of server process requested, with deletion of state")
_define("master_proxy_failed", 1209, "Master terminating because a Proxy failed")
_define("master_resolver_failed", 1210, "Master terminating because a Resolver failed")
_define("tag_throttled", 1213, "Transaction tag is being throttled")
_define("platform_error", 1500, "Platform error")
_define("io_error", 1510, "Disk i/o operation failed")
_define("file_not_found", 1511, "File not found")
_define("checksum_failed", 1520, "A data checksum failed")
_define("io_timeout", 1521, "A disk IO operation failed to complete in a timely manner")
_define("file_corrupt", 1522, "A structurally corrupt data file was detected")
_define("client_invalid_operation", 2000, "Invalid API call")
_define("key_outside_legal_range", 2004, "Key outside legal range")
_define("inverted_range", 2005, "Range begin key larger than end key")
_define("invalid_option_value", 2006, "Option set with an invalid value")
_define("too_many_tags", 2114, "Too many tags set on transaction")
_define("tag_too_long", 2115, "Tag set on transaction is too long")
_define("used_during_commit", 2017, "Operation issued while a commit was outstanding")
_define("key_too_large", 2102, "Key length exceeds limit")
_define("value_too_large", 2103, "Value length exceeds limit")
_define("transaction_too_large", 2101, "Transaction exceeds byte limit")
_define("unknown_error", 4000, "An unknown error occurred")
_define("internal_error", 4100, "An internal error occurred")

# Errors on which fdb clients retry the transaction (ref: NativeAPI onError
# retries exactly: transaction_too_old, future_version, not_committed,
# commit_unknown_result, process_behind, database_locked,
# proxy_memory_limit_exceeded, tag_throttled):
_RETRYABLE = frozenset({1007, 1009, 1020, 1021, 1037, 1038, 1042, 1213})


def error(name: str, message: str = "") -> FdbError:
    """Construct a fresh error instance by name, e.g. ``error("not_committed")``.

    ``message`` overrides the registry's default text (the code always
    comes from the registry, so diagnosis-carrying errors stay
    numerically identical to plain ones)."""
    code, msg = _REGISTRY[name]
    return FdbError(name, code, message or msg)


class ActorCancelled(FdbError):
    """Raised inside an actor when it is cancelled (ref: actor_cancelled).

    Distinct subclass so the scheduler can throw it into coroutines and
    distinguish cancellation from user errors.
    """

    def __init__(self):
        super().__init__("operation_cancelled", 1101, "Asynchronous operation cancelled")


def internal_error(msg: str = "") -> FdbError:
    return FdbError("internal_error", 4100, msg or "An internal error occurred")
