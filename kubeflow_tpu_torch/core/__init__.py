"""Runtime and communication foundation of the port: meshes over ranks,
the env-contract bootstrap and the collectives (``kubeflow_tpu/core``)."""

from kubeflow_tpu_torch.core.mesh import (  # noqa: F401
    Axis,
    Mesh,
    MeshSpec,
    build_mesh,
    current_mesh,
    mesh_context,
    slice_topology,
)
from kubeflow_tpu_torch.core.distributed import (  # noqa: F401
    DistributedConfig,
    initialize_from_env,
    launch,
)
