"""The SPMD word count over virtual shards: the one-shot step
(``shuffle``), the streaming engine (``streaming``) and its pipeline
core, step objects and host merge table; the streaming grep
(``grepstream``) on the same core."""
