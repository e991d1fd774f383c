from . import hash, hash_with_instance, spec  # noqa: F401
