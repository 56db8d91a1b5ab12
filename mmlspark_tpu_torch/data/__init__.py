"""Data plumbing of the port.  Only the transport framing of the data
service is ported so far (`service.transport`): the serving tiers' KV
handoff rides it.  The data service itself waits for ROADMAP A12."""
