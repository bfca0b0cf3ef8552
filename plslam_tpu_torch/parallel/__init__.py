"""Distribution over ``torch.distributed`` (``plslam_tpu.parallel``):
landmark-sharded BA (``dist_ba``), the kf-block global BA (``dist_gba``),
the sharded matcher and edge-sharded pose graph (``dist_match``), the
host-major 2-axis mesh (``multihost``), the mesh helpers and collectives
(``mesh``) and an SPMD launcher of rank processes (``launch``).

One process per rank (SPMD): every rank holds the same host inputs,
computes its shard, and the collectives of ``mesh`` stand where the JAX
package's ``shard_map`` programs psum.
"""
