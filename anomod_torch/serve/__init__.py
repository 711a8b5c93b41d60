"""The multi-tenant serving plane on the card (counterpart of
``anomod/serve/``): admission control (``queues``), seeded traffic
(``traffic``), bucketed lane-stacked dispatch over the device state pool
(``batcher``) and the virtual-clock engine (``engine``)."""
