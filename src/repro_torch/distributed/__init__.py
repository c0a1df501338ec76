"""Training-side distribution on ``torch.distributed``: sharding rules
(DP/FSDP/TP/EP/SP) as DTensor placements, int8 error-feedback gradient
compression, and a GPipe pipeline, the reference's ``distributed/``.

Naming note: despite the name, this package has nothing to do with
*cache* distribution.  It shards model **parameters and activations**
across a device mesh inside one training/serving job.  Distributing the
KV *cache* across processes/nodes — socket-served cache nodes,
consistent-hash routing, replication — is the reference's ``cluster``
package (see ``docs/ARCHITECTURE.md``)."""
