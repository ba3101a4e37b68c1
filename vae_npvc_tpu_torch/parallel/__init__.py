"""Parallel training and inference over ``torch.distributed`` process
groups: meshes of named axes (``mesh``), collectives over an axis
(``comm``), the data-parallel step (``shard``), model-axis sharding
(``tp``), the pipelined decoder stack (``pp``) and sequence-parallel
inference (``halo``, ``seq_infer``).

Counterpart of ``vae_npvc_tpu/parallel``: one process per rank in place of
one ``jax.sharding.Mesh`` over the devices of a process, explicit
collectives where the JAX package has ``psum``/``pmean``/``all_gather``/
``ppermute`` inside ``shard_map``.
"""
