"""Published configurations of the language models the port serves."""
