"""Distribution of the port: the device mesh (``mesh``), the sharded codec
steps and collectives (``sharded``) and the multi-device dry run
(``dryrun``)."""
