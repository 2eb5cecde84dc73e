from . import flow, streaming_dmd, segment  # noqa: F401
