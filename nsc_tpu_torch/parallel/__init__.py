from nsc_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    assert_replicated,
    make_mesh,
    make_parallel_infer,
    make_parallel_train_step,
    replicate,
    shard_batch,
)
