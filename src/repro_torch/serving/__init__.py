"""Serving on the paged, chunked, greedy path: the page pool and radix cache
(``kv_pool``), the ``InferenceEngine`` (``engine``) and the request-lifecycle
``EngineCore`` (``core``)."""
