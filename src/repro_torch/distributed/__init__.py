from repro_torch.distributed.sharding import (  # noqa: F401
    MeshInfo,
    constrain,
    current_mesh_info,
    logical_spec,
    param_shardings,
    set_mesh_info,
    use_mesh_info,
)
