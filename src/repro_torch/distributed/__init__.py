"""Sharding rules (``sharding``), the ambient sharding context models read
(``context``), and the data-parallel BNS step's collectives (through
``core.bns.make_distributed_bns_step``). Port of ``repro.distributed``,
without ``emulate``: it splits XLA's CPU into devices that really compute,
for the reference's fleet tests; the port's fleet (``serving.fleet``) runs
those tiers without it, gloo process groups run its multi-rank tests, and
the dry run (``launch.dryrun``) lays the production meshes over a fake
process group of 256 or 512 ranks, which computes no numbers."""
