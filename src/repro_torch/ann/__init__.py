from .exact import ExactIndex
from .scorescan import (ScoreScanIndex, coordinated_scan_search,
                        pack_leftover_shard, policy_auth_words,
                        scorescan_factory)
