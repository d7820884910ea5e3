"""Device-mesh parallelism: batched carriers/UEs sharded across several
devices — the replacement of the reference's worker-pool TTI pipeline
(SURVEY.md §2.8)."""
