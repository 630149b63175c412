"""Model zoo: the dense transformer family and its flow head."""
