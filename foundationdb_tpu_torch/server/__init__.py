"""Server roles of the port (ref: fdbserver/). So far the resolver
role (`resolver_role.Resolver`) over the port's conflict-set backends,
with the message vocabulary it speaks (`types`)."""

from . import types

__all__ = ["types"]
