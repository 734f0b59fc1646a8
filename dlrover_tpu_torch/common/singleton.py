"""Thread-safe singleton base (role of dlrover/python/common/singleton.py).

Copy of ``dlrover_tpu/common/singleton.py`` (the port imports nothing
of the JAX package).
"""

import threading


class Singleton:
    _instance_lock = threading.Lock()

    @classmethod
    def singleton_instance(cls, *args, **kwargs):
        if not hasattr(cls, "_instance"):
            with cls._instance_lock:
                if not hasattr(cls, "_instance"):
                    cls._instance = cls(*args, **kwargs)
        return cls._instance

    @classmethod
    def reset_singleton(cls):
        """Drop the cached instance (tests)."""
        with cls._instance_lock:
            if hasattr(cls, "_instance"):
                del cls._instance
