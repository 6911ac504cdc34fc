"""The distributed layer on torch.distributed: process meshes (mesh), the
landmark-sharded Schur BA and the sharded batches (dist_ba), and a
launcher of spawned ranks (launch)."""
