from .mesh import (  # noqa: F401
    all_reduce_sum,
    destroy,
    free_port,
    initialize_distributed,
    is_distributed,
    process_allgather,
    rank,
    sync_hosts,
    world_size,
)
