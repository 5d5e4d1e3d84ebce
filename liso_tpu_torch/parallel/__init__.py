"""Data parallelism: the process group, sharding and cross-rank sums
(`mesh`), and the multi-rank dry run (`dryrun`)."""
