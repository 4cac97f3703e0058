"""Distribution utilities: the sharding rules, the serving mesh's placement
and the fault machinery."""
