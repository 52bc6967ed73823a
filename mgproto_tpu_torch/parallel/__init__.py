"""The distributed runtime of the port (counterpart of mgproto_tpu/parallel):

  * `mesh`: process-group bring-up and the [data, model] rank grid;
  * `collectives`: the collectives with gradients the sharded step uses;
  * `sharding`: where each part of the train state lives, and the class
    slabs of the GMM, the bank and the mean optimizer;
  * `multihost`: host-side gathers and agreements across the ranks;
  * `trainer`: `ShardedTrainer`, the train step over the mesh.

The JAX package partitions one SPMD program; here each rank is a process
with one device, and every collective is written out (torch.distributed).
"""
