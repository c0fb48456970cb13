"""The fault-tolerance soak: `stress_orchestrator` churns `ft_peer`
processes (and, on request, the master) until the clock runs out."""
