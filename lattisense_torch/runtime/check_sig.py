"""Task-signature and parameter validation before a task runs.

Port of ``lattisense_tpu/runtime/check_sig.py`` over the port's carriers and
``BfvContext`` (``rlk.level``, ``glk.keys``). Every error string is the
reference SDK's word for word (cxx_sdk_v2/check_sig.h:53-268), since the
reference's tests assert them.
"""

from ..params import BfvParams, CkksParams
from ..schemes.types import (Ciphertext, Plaintext, PlaintextMul, PlaintextRingt)

_TYPE_NAMES = ('rlk', 'glk', 'pt_ringt', 'pt_mul', 'pt', 'ct', 'ct3')


def _value_type_name(flat0, declared: str) -> str:
    """Runtime type tag of a user-provided value (CxxArgumentType analog)."""
    if isinstance(flat0, Ciphertext):
        return 'ct3' if flat0.degree == 2 else 'ct'
    if isinstance(flat0, PlaintextRingt):
        return 'pt_ringt'
    if isinstance(flat0, PlaintextMul):
        return 'pt_mul'
    if isinstance(flat0, Plaintext):
        return 'pt'
    return declared


def flatten(x):
    if isinstance(x, (list, tuple)):
        out = []
        for a in x:
            out += flatten(a)
        return out
    return [x]


def check_with_sig(arg_id: str, value, expected_row: dict):
    """Validate one (id, value) pair against its signature row
    (reference: check_with_sig, check_sig.h:53)."""
    expected_id = expected_row['id']
    if arg_id != expected_id:
        raise RuntimeError(f'For argument {arg_id}, expected id is {expected_id}, '
                           f'but input id is {arg_id}.')
    flat = flatten(value)
    got_type = _value_type_name(flat[0], expected_row['type'])
    if got_type != expected_row['type']:
        raise RuntimeError(f'For argument {arg_id}, expected type is '
                           f"{expected_row['type']}, but input type is {got_type}.")
    expected_size = 1
    for s in expected_row['size']:
        expected_size *= s
    if len(flat) != expected_size:
        raise RuntimeError(f'For argument {arg_id}, expected size is {expected_size}, '
                           f'but input size is {len(flat)}.')
    if 'level' in expected_row:
        levels = {getattr(v, 'level', expected_row['level']) for v in flat}
        if len(levels) > 1:
            raise RuntimeError(f'For argument {arg_id}, elements have inhomogeneous '
                               f'levels {sorted(levels)}.')
        got_level = levels.pop()
        if got_level != expected_row['level']:
            raise RuntimeError(f'For argument {arg_id}, expected level is '
                               f"{expected_row['level']}, but input level is {got_level}.")


def check_context_for_key_signatures(context, key_signature: dict):
    """Context must hold rlk/glk/btp-swk at ≥ the required level
    (reference: check_sig.h:92)."""
    rlk_level_sig = key_signature.get('rlk', -1)
    if rlk_level_sig != -1:
        if context.rlk is None or rlk_level_sig > context.rlk.level:
            raise RuntimeError('Level of relin key is smaller than the expected level.')
    for gal_el, glk_level_sig in key_signature.get('glk', {}).items():
        gal_el = int(gal_el)
        ksk = context.glk.keys.get(gal_el)
        if ksk is None or glk_level_sig > ksk.level:
            raise RuntimeError('Level of Galois key is smaller than the expected level.')
    for name, (lvl, sp_lvl) in key_signature.get('ckks_btp_swk', {}).items():
        ksk = context.swk.get(name)
        if ksk is None or lvl > ksk.level:
            raise RuntimeError(f'Level of bootstrap switch key "{name}" is smaller '
                               f'than the expected level.')


def check_parameter(context, parameter: dict):
    """Context parameters must equal the task's compile-time parameters
    (reference: check_parameter, check_sig.h:118)."""
    if 'n' not in parameter:
        raise RuntimeError("Parameter JSON missing 'n' field")
    if 'q' not in parameter:
        raise RuntimeError("Parameter JSON missing 'q' field")
    p = context.params
    name = 'BFV' if isinstance(p, BfvParams) else 'CKKS'
    if parameter['n'] != p.n:
        raise RuntimeError(f"{name} parameter N mismatch: expected {parameter['n']}, "
                           f'got {p.n}')
    if name == 'BFV' and parameter.get('t') is not None and parameter['t'] != p.t:
        raise RuntimeError(f"BFV parameter t mismatch: expected {parameter['t']}, "
                           f'got {p.t}')
    if len(parameter['q']) != len(p.q):
        raise RuntimeError(f'{name} parameter Q count mismatch: expected '
                           f"{len(parameter['q'])}, got {len(p.q)}")
    for i, (a, b) in enumerate(zip(parameter['q'], p.q)):
        if a != b:
            raise RuntimeError(f'{name} parameter Q[{i}] mismatch: expected {a}, got {b}')
    if len(parameter.get('p', [])) != len(p.p):
        raise RuntimeError(f'{name} parameter P count mismatch: expected '
                           f"{len(parameter.get('p', []))}, got {len(p.p)}")
    for i, (a, b) in enumerate(zip(parameter.get('p', []), p.p)):
        if a != b:
            raise RuntimeError(f'{name} parameter P[{i}] mismatch: expected {a}, got {b}')


def check_signatures(context, signature: dict, input_values: dict, output_rows: list):
    """Full pre-run validation (reference: check_signatures, check_sig.h:226)."""
    algo = signature.get('algorithm')
    if algo == 'bfv' and not isinstance(context.params, BfvParams):
        raise RuntimeError('Algorithm is BFV but context is not BfvContext')
    if algo == 'ckks' and not isinstance(context.params, CkksParams):
        raise RuntimeError('Algorithm is CKKS but context is not CkksContext/CkksBtpContext')
    for row in signature['online'] + signature.get('offline', []):
        if row['phase'] == 'out':
            continue
        if row['id'] not in input_values:
            raise RuntimeError(f"Missing input argument \"{row['id']}\".")
        check_with_sig(row['id'], input_values[row['id']], row)
    check_context_for_key_signatures(context, signature['key'])
