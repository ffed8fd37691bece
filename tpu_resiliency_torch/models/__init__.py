"""The reference workload the port's resiliency stack guards."""
