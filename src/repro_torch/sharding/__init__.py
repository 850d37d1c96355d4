"""How the port lays state out over devices."""
