"""Distribution layer of the port: the logical-axis sharding policy
(`sharding`), the sequence split over the ``model`` axis and its
collectives (`seq_parallel`), elastic re-meshing and re-placement of the
train state and the serving side's agent-set versions (`elastic`), and
the process-parallel super-hub shard workers of the hubs-of-hubs
federation (`federation`)."""
