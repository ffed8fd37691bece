"""The port's control-plane store (counterpart of ``tpu_resiliency/store``).

Only the pieces the async checkpoint core imports are here so far:
:func:`.protocol.itob` and :class:`.client.StoreError`.  The wire protocol,
the clients, the servers and the barrier come with the store slice
(``ROADMAP.md`` Queue 1 item 5).
"""
