"""JAX ML extension (the reference's Vowpal Wabbit layer).

The reference pipes rkmh output through a vw binary for coinfection /
lineage models (/root/reference/model_docker/run_models.sh:3-10,
scripts/train_the_wabbit.sh).  `rkmh_tpu.ml.wabbit` is the clean-room
stand-in: same text formats in and out, feature-hashed linear models
trained with jax/optax on device.
"""
