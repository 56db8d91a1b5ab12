"""The data service's transport module (the port of
`mmlspark_tpu/data/service/transport.py`'s framing): what the serving
tiers' KV handoff needs.  The dispatcher, workers and their process spawn
wait for ROADMAP A12."""
