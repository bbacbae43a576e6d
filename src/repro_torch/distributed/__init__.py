"""Distribution layer of the port: serving-side elasticity (agent-set
versions, `elastic`) and the process-parallel super-hub shard workers of
the hubs-of-hubs federation (`federation`)."""
