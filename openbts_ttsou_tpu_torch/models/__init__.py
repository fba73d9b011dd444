"""End-to-end pipeline models: the uplink of the multi-carrier Transceiver."""
