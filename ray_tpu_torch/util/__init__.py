"""Process-local observability of the port: ``metrics``, ``tracing`` and
``phases``, own copies of their ``ray_tpu.util`` counterparts without the
cluster halves (ROADMAP.md, queue A)."""
