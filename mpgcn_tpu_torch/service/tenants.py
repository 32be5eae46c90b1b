"""The multi-tenant fleet's typed outcomes (counterpart of
mpgcn_tpu/service/tenants.py:41-44). The single-tenant server answers an
explicit tenant with ``REJECT_UNKNOWN_TENANT``, and its HTTP front maps
all four to status codes; the fleet itself is not ported yet."""

SHED_TENANT_QUOTA = "shed-tenant-quota"
REJECT_BREAKER_OPEN = "rejected-breaker-open"
REJECT_UNKNOWN_TENANT = "rejected-unknown-tenant"
REJECT_TENANT_UNAVAILABLE = "rejected-tenant-unavailable"
