from .mesh import window_mesh, sharded_align_walk  # noqa: F401
