from pyxu_tpu_torch.parallel.consensus import ConsensusADMM  # noqa: F401
from pyxu_tpu_torch.parallel.halo import (  # noqa: F401
    ShardedStencil,
    halo_exchange,
)
from pyxu_tpu_torch.parallel.mesh import (  # noqa: F401
    P,
    auto_mesh,
    init_distributed,
    replicate,
    shard,
)
from pyxu_tpu_torch.parallel.nufft import (  # noqa: F401
    ShardedNUFFT,
    ShardedNUFFT3,
)
from pyxu_tpu_torch.parallel.outofcore import (  # noqa: F401
    StreamedCondatVu,
    streamed_block_diag,
    streamed_map_overlap,
)
from pyxu_tpu_torch.parallel.sharded import (  # noqa: F401
    sharded_block_diag,
    with_sharding,
)
